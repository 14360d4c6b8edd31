"""PyTorch port, the FLUX.2 / FLUX.2-Klein slice against the JAX package,
fp32 on the CPU: the gated (SwiGLU) FFN, the tiny FLUX transformer in both
``mlp_style``s without a pooled vector, the LM's tied-embedding logits (GQA,
and Gemma3-tiny), the caption upsampler's greedy ids and strings, both
adapters' ``encode_prompt`` with the upsampler, the tiny FLUX.2's T2I and
multi-reference I2I rollouts from the same x0 and noise, the replay ratio in
the rollout order, the GRPO loss and LoRA gradients against the JAX
``_grad_fn``, the pin of F13 (FLUX.2 inherits Kontext's row-0 condition
ids), one GRPO epoch through ``load_trainer`` on
tests/fixtures/smoke_grpo_flux2.yaml, and LTX-2's enhanced prompts (the
pretrained import of both model types: tests/test_torch_port_import.py).

Both packages run on the JAX adapter's weights and a LoRA with a non-zero
``b`` through the weight bridge; the velocities take the JAX timestep
features (``shared_time_features``, see tests/test_torch_port_flux.py). The
bars are ROADMAP's "Match": a single forward 2e-5, a trajectory 1e-4; the
generated ids are equal."""
import copy
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_flux import _config_dict, _host, _jax_features, _jax_noise, shared_time_features  # noqa: F401
from test_torch_port_kontext import _records

from flow_factory_tpu_torch.models.layers import build_module
from flow_factory_tpu_torch.utils import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = os.path.join(REPO, "dataset", "multi_ref_image")
SMOKE = os.path.join(REPO, "tests", "fixtures", "smoke_grpo_flux2.yaml")
SEED = 13
#: the I2I rollout's rows: the two-reference record twice, then the one-reference record twice
ROWS = [0, 0, 1, 1]
T2I_PROMPTS = ["a red fox in fresh snow"] * 2 + ["a lighthouse at dusk"] * 2
#: the tiny FLUX.2 of the adapter tests: the gated FFN and the caption upsampler
FLUX2 = {"model_type": "flux2", "mlp_style": "swiglu", "use_caption_upsampler": True}
#: an adapter of the text encoder alone, in both packages: the encoder is
#: then the trained component (no transformer to put a LoRA on)
ENCODER_ALONE = {"load_components": ["text_encoder"], "finetune_type": "full", "target_modules": "text_encoder"}


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


@pytest.fixture(autouse=True)
def _restore_sigterm():
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _moved(params, rng, scale=0.02):
    return jax.tree.map(lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32), _host(params))


# ---------------------------------------------------------------------------
# Layers: the gated FFN, the transformer in both FFN forms, the LM's logits
# ---------------------------------------------------------------------------

def test_swiglu_feedforward_matches_jax():
    """``SwiGLUFeedForward`` against the JAX ``FeedForward(activation="swiglu")``
    through the bridge (``fc1``, [gate; value] along its output, is
    ``linear_in``; ``fc2`` is ``linear_out``): 2e-5."""
    from flow_factory_tpu.models.layers import FeedForward as JFF
    from flow_factory_tpu_torch.models.layers import SwiGLUFeedForward

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 32)).astype(np.float32)
    jm = JFF(32, mult=4.0, activation="swiglu")
    params = _moved(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"], rng)
    theirs = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x)))
    tm = build_module(lambda: SwiGLUFeedForward(32, 128, torch.float32), torch.device("cpu"), torch.float32, None)
    weights.load_component(tm, weights.convert(params, {"fc1": "linear_in", "fc2": "linear_out"}))
    assert tm.linear_in.weight.shape == (256, 32) and tm.linear_out.weight.shape == (32, 128)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mlp_style", ["gelu_tanh", "swiglu"])
def test_flux_transformer_without_pooled_matches_jax_in_both_mlp_styles(mlp_style, shared_time_features):
    """The tiny FLUX transformer as FLUX.2's tiny preset builds it (context
    32, ``pooled_dim`` 0: no text embedder in either package) with the
    double blocks' FFN ``gelu_tanh`` or ``swiglu``, on the flax init
    perturbed by 0.02, through ``flux2_transformer_map``: 2e-5."""
    from flow_factory_tpu.models.flux.adapter import Flux1Adapter as JAd
    from flow_factory_tpu.models.flux.transformer import FluxConfig as JCfg, FluxTransformer as JT
    from flow_factory_tpu_torch.models.flux.transformer import FluxConfig, FluxTransformer

    rng = np.random.default_rng(0)
    B, Lt = 2, 5
    args = [rng.standard_normal((B, 16, 16)).astype(np.float32), np.asarray([750.0, 300.0], np.float32),
            rng.standard_normal((B, Lt, 32)).astype(np.float32), np.zeros((B, 0), np.float32),
            JAd.latent_image_ids(8, 8), np.zeros((Lt, 3), np.float32), np.full((B,), 3.5, np.float32)]
    kw = dict(dtype="float32", context_dim=32, pooled_dim=0, mlp_style=mlp_style)
    jm = JT(JCfg.tiny(**kw))
    params = _moved(jax.jit(jm.init)(jax.random.PRNGKey(0), *args)["params"], rng)
    theirs = np.asarray(jax.jit(jm.apply)({"params": params}, *map(jnp.asarray, args)))
    cfg = FluxConfig.tiny(**kw)
    tm = build_module(lambda: FluxTransformer(cfg), torch.device("cpu"), torch.float32, None)
    weights.load_component(tm, weights.convert(params, *weights.flux2_transformer_map(
        cfg.num_double_blocks, cfg.num_single_blocks, mlp_style)))
    sd = tm.state_dict()
    assert not any(k.startswith("time_text_embed.text_embedder") for k in sd)
    if mlp_style == "swiglu":
        assert sd["transformer_blocks.0.ff_context.linear_in.weight"].shape == (512, 64)
    else:
        assert sd["transformer_blocks.0.ff_context.net.0.proj.weight"].shape == (256, 64)
    with torch.no_grad():
        ours = tm(*[torch.from_numpy(a) for a in args[:3]], None, *map(torch.from_numpy, args[4:])).numpy()
    assert ours.shape == theirs.shape == (B, 16, 16)
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)


def _lm_pair(preset: str):
    """A JAX ``LMEncoder`` of ``preset`` (fp32), its params moved off the
    init, and the port's twin through the bridge."""
    from flow_factory_tpu.models.text_encoders import lm as J
    from flow_factory_tpu_torch.models.text_encoders import lm as T

    cfg_j, cfg_t = getattr(J.LMConfig, preset)(dtype="float32"), getattr(T.LMConfig, preset)(dtype="float32")
    module = J.LMEncoder(cfg_j)
    params = _moved(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"],
                    np.random.default_rng(5), 0.05)
    port = build_module(lambda: T.LMEncoder(cfg_t), torch.device("cpu"), torch.float32, None)
    weights.load_component(port, weights.convert(params, *weights.lm_decoder_map(
        cfg_t.num_layers, gemma=cfg_t.arch == "gemma3")))
    return module, params, port


@pytest.mark.parametrize("preset", ["tiny", "gemma3_tiny"])
def test_lm_tied_logits_match_jax(preset):
    """``return_logits``: the final states and the tied-embedding logits of
    16-token rows with a pad tail (GQA 4 q / 2 kv heads; Gemma3-tiny's
    sliding layers) against the JAX ``LMEncoder``: states 2e-5, logits 2e-5
    of their max; the logits are the bare product with the token table (no
    Gemma √width scale), fp32."""
    import torch.nn.functional as F

    module, params, port = _lm_pair(preset)
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 1000, (2, 16)).astype(np.int32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 9:], ids[1, 9:] = 0, 0
    h_j, logits_j = jax.jit(module.apply, static_argnames="return_logits")(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask), return_logits=True)
    with torch.no_grad():
        h_t, logits_t = port(torch.from_numpy(ids).long(), torch.from_numpy(mask), return_logits=True)
        assert torch.equal(port(torch.from_numpy(ids).long(), torch.from_numpy(mask)), h_t)
        assert torch.equal(logits_t, F.linear(h_t, port.model.embed_tokens.weight))
    assert logits_t.dtype == torch.float32 and logits_t.shape == (2, 16, 1000)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=2e-5, rtol=0)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=2e-5 * float(np.abs(logits_j).max()), rtol=0)


def test_mistral_small_preset_equals_jax():
    """``LMConfig.mistral_small`` has the JAX preset's value on every field:
    vocabulary 131072, width 5120, 40 layers, 32 q / 8 kv heads of 128, MLP
    32768; 22.90 B parameters on the meta device."""
    import dataclasses

    from flow_factory_tpu.models.text_encoders.lm import LMConfig as J
    from flow_factory_tpu_torch.models.text_encoders.lm import LMConfig, LMEncoder

    ours, theirs = dataclasses.asdict(LMConfig.mistral_small()), dataclasses.asdict(J.mistral_small())
    assert ours == theirs
    with torch.device("meta"):
        n = sum(p.numel() for p in LMEncoder(LMConfig.mistral_small()).parameters())
    assert round(n / 1e9, 2) == 22.90


# ---------------------------------------------------------------------------
# The caption upsampler
# ---------------------------------------------------------------------------

TEMPLATE = "Rewrite as a detailed image description: {prompt}\n"
#: the last prompt fills all 16 slots with the template: no room to generate
CAPTION_PROMPTS = ["a cat", "a dog on a hill", "a very long prompt that fills every slot of the row and more"]


def test_greedy_ids_and_strings_equal_jax():
    """The greedy decode of the tiny LM over 16-slot rows (the template and
    prompt, then each row's cursor at its first pad slot, 24 steps) gives
    the JAX ``_greedy_generate``'s ids exactly; the upsampler's strings equal
    the JAX ``LMCaptionUpsampler``'s, are the same on a second call, and a
    row with no free slot gives its prompt back."""
    from flow_factory_tpu.models.text_encoders.caption import LMCaptionUpsampler as JUp, _greedy_generate
    from flow_factory_tpu_torch.models.text_encoders.caption import LMCaptionUpsampler, greedy_generate
    from flow_factory_tpu_torch.utils.tokenizer import HashTokenizer

    module, params, port = _lm_pair("tiny")
    tok = HashTokenizer(vocab_size=1000, max_length=16, eos_token_id=2, pad_token_id=0)
    enc = tok([TEMPLATE.format(prompt=p) for p in CAPTION_PROMPTS], max_length=16)
    ids, cursor = enc["input_ids"], enc["attention_mask"].sum(axis=1).astype(np.int32)
    assert cursor.tolist()[2] == 16 and max(cursor[:2]) < 16
    theirs = np.asarray(_greedy_generate(module.apply, params, jnp.asarray(ids), jnp.asarray(cursor), 24))
    ours = greedy_generate(port, torch.from_numpy(ids).long(), torch.from_numpy(cursor).long(), 24).numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert np.array_equal(ours[2], ids[2]) and not np.array_equal(ours[:2], ids[:2])

    j_up = JUp(module, params, tok, max_new_tokens=24, max_length=16)
    p_up = LMCaptionUpsampler(port, tok, max_new_tokens=24, max_length=16)
    got = p_up(CAPTION_PROMPTS)
    assert got == j_up(CAPTION_PROMPTS) == p_up(CAPTION_PROMPTS)
    assert got[2] == CAPTION_PROMPTS[2] and all(g.startswith("<ids:") for g in got[:2])


# ---------------------------------------------------------------------------
# The adapters
# ---------------------------------------------------------------------------

def _flux2_config(model=None, **train):
    return _config_dict(data={"dataset_dir": DATASET}, model={**FLUX2, **(model or {})},
                        train={"trainer_type": "grpo", "clip_range": 0.2, "adv_clip_range": 1.5, **train})


def _jax_adapter(cfg):
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(1)
    try:
        return jax_load(JArgs.from_dict(cfg))
    finally:
        set_world_size_override(None)


def _port_twin(cfg, flax_params):
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    pa = load_adapter(Arguments.from_dict(cfg), device="cpu")
    pa.load_state_dicts(weights.flux2_state_dicts(flax_params, pa.component_configs))
    return pa


@pytest.fixture(scope="module")
def both():
    """The tiny FLUX.2 in both packages (the gated FFN, the caption
    upsampler) on the JAX adapter's weights and a LoRA with non-zero ``b``;
    each package's preprocessing of dataset/multi_ref_image; and two
    Flow-SDE rollouts each from the same x0 and noise with the same timestep
    features: T2I of ``T2I_PROMPTS``, and I2I of the records' rows ``ROWS``
    on the JAX package's condition tokens."""
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.models import layers as TL

    recs = _records()
    prompts = [recs["prompt"][r] for r in ROWS]
    ja = _jax_adapter(_flux2_config({"attn_backend": "native"}))
    rng = np.random.default_rng(6)
    lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
            for p, ab in _host(ja.trainable["transformer"]).items()}
    ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
    set_world_size_override(1)
    try:
        j_pre = ja.preprocess_func(copy.deepcopy(recs))
        ja.rollout()
        j_t2i = ja.inference(prompt=T2I_PROMPTS, seed=SEED)
        j_i2i = ja.inference(prompt=prompts, seed=SEED, cond_latents=j_pre["cond_latents"][ROWS],
                             cond_ids=j_pre["cond_ids"][ROWS])
    finally:
        set_world_size_override(None)
    flax_params = _host(ja.params)

    pa = _port_twin(_flux2_config(), flax_params)
    module_map = weights.flux2_component_maps(pa.component_configs)["transformer"][0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))
    p_pre = pa.preprocess_func(copy.deepcopy(recs))
    h, w, c = pa.latent_shape(32, 32)
    x0, noise = _jax_noise(len(ROWS), (h, w, c), ((h // 2) * (w // 2), 4 * c), 4)
    draws = dict(x0=torch.tensor(x0), noise=[torch.tensor(n) for n in noise])
    real = TL.sinusoidal_timestep_embedding
    TL.sinusoidal_timestep_embedding = _jax_features
    try:
        pa.rollout()
        p_t2i = pa.inference(prompt=T2I_PROMPTS, **draws)
        p_i2i = pa.inference(prompt=prompts, cond_latents=j_pre["cond_latents"][ROWS],
                             cond_ids=j_pre["cond_ids"][ROWS], **draws)
    finally:
        TL.sinusoidal_timestep_embedding = real
    pa.train()
    return dict(ja=ja, pa=pa, recs=recs, j_pre=j_pre, p_pre=p_pre, module_map=module_map,
                samples={"t2i": (j_t2i, p_t2i), "i2i": (j_i2i, p_i2i)})


def test_registry_resolves_flux2_and_klein():
    """``flux2`` and ``flux2-klein`` resolve to the port's adapters, Klein a
    FLUX.2 whose preset a model id takes is ``klein``, FLUX.2's ``flux2``."""
    from flow_factory_tpu_torch.models.flux.flux2 import Flux2Adapter, Flux2KleinAdapter
    from flow_factory_tpu_torch.models.flux.kontext import Flux1KontextAdapter
    from flow_factory_tpu_torch.models.registry import _NOT_PORTED, resolve_adapter_class

    assert resolve_adapter_class("flux2") is Flux2Adapter
    assert resolve_adapter_class("flux2-klein") is Flux2KleinAdapter
    assert issubclass(Flux2KleinAdapter, Flux2Adapter) and issubclass(Flux2Adapter, Flux1KontextAdapter)
    assert (Flux2Adapter.default_variant, Flux2KleinAdapter.default_variant) == ("flux2", "klein")
    assert _NOT_PORTED == {}


@pytest.mark.parametrize("name", ["klein", "flux2"])
def test_presets_equal_jax(name):
    """The ``klein`` and ``flux2`` presets have the JAX presets' values on
    every field of every component, in both FFN forms; Klein's transformer
    is 6.17 B parameters and FLUX.2's gated one 29.89 B on the meta device."""
    import dataclasses

    from flow_factory_tpu.models.flux import flux2 as J
    from flow_factory_tpu_torch.models.flux import flux2 as T
    from flow_factory_tpu_torch.models.flux.transformer import FluxTransformer

    for style in ("gelu_tanh", "swiglu"):
        ours, theirs = T._preset(name, "auto", "bfloat16", style), J._preset(name, "auto", "bfloat16", style)
        assert ours["max_length"] == theirs["max_length"] == 512
        for key in ("transformer", "vae", "lm"):
            o, t = dataclasses.asdict(ours[key]), dataclasses.asdict(theirs[key])
            assert {k: o[k] for k in o.keys() & t.keys()} == {k: t[k] for k in o.keys() & t.keys()}, (key, style)
    cfg = T._preset(name, "auto", "bfloat16", "gelu_tanh" if name == "klein" else "swiglu")["transformer"]
    with torch.device("meta"):
        n = sum(p.numel() for p in FluxTransformer(cfg).parameters())
    assert round(n / 1e9, 2) == {"klein": 6.17, "flux2": 29.89}[name]


@pytest.mark.parametrize("kind", ["flux2", "klein"])
def test_encode_prompt_with_the_upsampler_matches_jax(both, kind):
    """Both adapters' ``encode_prompt`` under ``use_caption_upsampler`` (Klein
    built with its text encoder alone): the rewritten prompts equal JAX's,
    then the LM states (B, 16, 32) 2e-5 and the mask-mean
    ``pooled_prompt_embeds`` 2e-5 of JAX's; the states differ from those of
    the prompts as given."""
    prompts = ["a cat", "a dog on a hill"]
    if kind == "flux2":
        ja, pa = both["ja"], both["pa"]
    else:
        model = {"model_type": "flux2-klein", **ENCODER_ALONE}
        ja = _jax_adapter(_flux2_config(model))
        pa = _port_twin(_flux2_config(model), _host(ja.params))
        assert set(pa.modules) == {"text_encoder"} and type(pa).__name__ == "Flux2KleinAdapter"
    rewritten = pa.caption_upsampler(prompts)
    assert rewritten == ja.caption_upsampler(prompts) and rewritten != prompts
    theirs, ours = ja.encode_prompt(prompts), pa.encode_prompt(prompts)
    assert set(ours) == set(theirs) == {"prompt_embeds", "pooled_prompt_embeds"}
    assert ours["prompt_embeds"].shape == (2, 16, 32) and ours["pooled_prompt_embeds"].shape == (2, 32)
    for key in theirs:
        np.testing.assert_allclose(ours[key].numpy(), theirs[key], atol=2e-5, rtol=0)
    up, pa.caption_upsampler = pa.caption_upsampler, None
    try:
        plain = pa.encode_prompt(prompts)["prompt_embeds"]
    finally:
        pa.caption_upsampler = up
    assert (plain - ours["prompt_embeds"]).abs().max() > 1e-3


def test_preprocess_matches_jax(both):
    """``preprocess_func`` on dataset/multi_ref_image: the upsampled prompts'
    embeddings and their pooled means 2e-5, the condition tokens 2e-5 and
    their ids equal to JAX's (the one-reference record padded with ids −1)."""
    j_pre, p_pre = both["j_pre"], both["p_pre"]
    assert set(p_pre) == set(j_pre) == {"prompt_embeds", "pooled_prompt_embeds", "cond_latents", "cond_ids"}
    np.testing.assert_array_equal(p_pre["cond_ids"], j_pre["cond_ids"])
    assert np.all(p_pre["cond_ids"][1, 256:] == -1.0)
    for key in ("prompt_embeds", "pooled_prompt_embeds", "cond_latents"):
        np.testing.assert_allclose(p_pre[key], j_pre[key], atol=2e-5, rtol=0)


@pytest.mark.parametrize("kind", ["t2i", "i2i"])
def test_rollouts_match_jax(both, kind):
    """The 4-step Flow-SDE rollouts, T2I and multi-reference I2I (the
    condition tokens on every step): every stored latent, the SDE steps'
    log-probs and the images within the trajectory bar 1e-4; the samples
    keep the prompts' pooled means, and the I2I samples their rows of the
    condition tokens and ids, as the JAX package's do."""
    j_samples, p_samples = both["samples"][kind]
    sde = np.nonzero(p_samples[0].extra_kwargs["noise_levels"])[0]
    assert len(sde) == 2
    for js, ps in zip(j_samples, p_samples):
        assert type(ps).__name__ == "ImageConditionSample"
        keys = {"pooled_prompt_embeds"} | ({"cond_latents", "cond_ids"} if kind == "i2i" else set())
        assert keys <= set(ps.extra_kwargs) and keys <= set(js.extra_kwargs)
        np.testing.assert_array_equal(ps.extra_kwargs.get("cond_ids"), js.extra_kwargs.get("cond_ids"))
        np.testing.assert_allclose(ps.extra_kwargs["pooled_prompt_embeds"], js.extra_kwargs["pooled_prompt_embeds"],
                                   atol=2e-5, rtol=0)
        assert ps.all_latents.shape == js.all_latents.shape == (5, 64, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.log_probs[sde], js.log_probs[sde], atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.image, js.image, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kind", ["t2i", "i2i"])
def test_replay_ratio_is_exactly_one_in_the_rollout_order(both, kind, shared_time_features):
    """The no-grad replay over FLUX.2's embed keys in the rollout's row order
    gives exp(new − old) == 1.0 exactly on every stored step."""
    pa, samples = both["pa"], both["samples"][kind][1]
    new = pa.replay_log_probs(samples)
    old = np.stack([s.log_probs for s in samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), (kind, i)


def _step_batch(samples, step, lib, old_shift=None, advantage=None):
    """The GRPO batch of ``samples`` at rollout step ``step``, with every
    embed key the samples carry."""
    from flow_factory_tpu_torch.samples import stack_samples

    bn = stack_samples(samples)
    s0 = samples[0]
    lat_map = s0.latent_index_map
    sig, nl = s0.extra_kwargs["sigmas"], s0.extra_kwargs["noise_levels"]
    full = lambda v: np.full((len(samples),), v, np.float32)
    old = bn["log_probs"][:, s0.log_prob_index_map[step]].astype(np.float32)
    embeds = [k for k in ("prompt_embeds", "pooled_prompt_embeds", "img_ids", "txt_ids", "cond_latents", "cond_ids")
              if getattr(s0, k, None) is not None]
    batch = dict(latents=bn["all_latents"][:, lat_map[step]], next_latents=bn["all_latents"][:, lat_map[step + 1]],
                 timestep=full(s0.timesteps[step]), sigma=full(sig[step]), sigma_next=full(sig[step + 1]),
                 noise_level=full(nl[step]), sigma_max=full(sig[1]),
                 old_log_prob=old if old_shift is None else (old + old_shift).astype(np.float32),
                 advantage=np.zeros(len(samples), np.float32) if advantage is None else advantage,
                 **{k: np.stack([getattr(s, k) for s in samples]).astype(np.float32) for k in embeds})
    return {**{k: lib(np.ascontiguousarray(v)) for k, v in batch.items()}, "guidance_scale": 3.5}


def test_grpo_loss_and_lora_grads_match_jax(both, shared_time_features):
    """One I2I micro-batch at its first SDE step through the JAX GRPO
    ``_grad_fn`` and the port's ``loss_and_grads``, the old log-probs moved
    so that the clip (0.2) binds on two rows: loss and every aux metric
    1e-5 (relative, absolute below 1e-7), every LoRA gradient leaf, the
    gated FFN's ``linear_in``/``linear_out`` and the fused
    ``linear1``/``linear2`` included, 1e-4 of its max."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer
    from test_torch_port_train import _leaf_close, _port_grads_as_flax

    ja, pa = both["ja"], both["pa"]
    samples = both["samples"]["i2i"][1]
    assert any(".ff.linear_in" in p for p in pa.trainable["transformer"])
    step = int(np.nonzero(samples[0].extra_kwargs["noise_levels"])[0][0])
    shift, adv = np.asarray([-0.05, 0.5, -0.4, -0.1], np.float32), np.asarray([1.2, -0.7, 1.4, -1.0], np.float32)
    jt, pt = object.__new__(JGRPO), object.__new__(GRPOTrainer)
    for trainer, adapter in ((jt, ja), (pt, pa)):
        trainer.training_args, trainer.use_guard, trainer.adapter = adapter.training_args, False, adapter
    (j_loss, j_aux), j_grads = jt._grad_fn(ja.trainable, ja.frozen_velocity_params(),
                                           _step_batch(samples, step, jnp.asarray, shift, adv), None)
    (loss, aux), grads = pt.loss_and_grads(_step_batch(samples, step, torch.from_numpy, shift, adv))
    assert sorted(aux) == sorted(j_aux)
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-5, atol=1e-7)
    for k in j_aux:
        np.testing.assert_allclose(float(aux[k]), float(j_aux[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert float(aux["train/clip_frac"]) == 0.5
    _leaf_close(_port_grads_as_flax(pa, grads, both["module_map"]),
                jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4, "flux2 grpo")


def test_f13_row0_condition_ids_are_pinned_in_both_packages(both, shared_time_features):
    """F13 holds for FLUX.2, which takes Kontext's velocity: the condition ids
    of the batch's first row serve every row. Replaying I2I rows 2 and 1
    (the one- and the two-reference record) in that order gives both rows
    the one-reference record's ids: the log-ratio is off 0 by more than
    2e-5 on both rows in both packages (about 5e-5 and 7e-4 at this size),
    and the packages' log-ratios agree within 2e-6."""
    ja, pa = both["ja"], both["pa"]
    step = int(np.nonzero(pa.scheduler.get_noise_levels())[0][0])
    ratios = []
    for adapter, samples, lib in ((ja, both["samples"]["i2i"][0], jnp.asarray),
                                  (pa, both["samples"]["i2i"][1], torch.from_numpy)):
        batch = _step_batch([samples[2], samples[1]], step, lib)
        with torch.no_grad():
            out = adapter.training_forward(adapter.trainable, batch)
        ratios.append(np.asarray(out.log_prob, np.float64) - np.asarray(batch["old_log_prob"], np.float64))
    for log_ratio in ratios:
        assert np.all(np.abs(log_ratio) > 2e-5), log_ratio
    np.testing.assert_allclose(ratios[1], ratios[0], atol=2e-6, rtol=0)


def test_grpo_epoch_through_load_trainer(tmp_path):
    """``load_trainer(cfg, device="cpu").start()`` on
    tests/fixtures/smoke_grpo_flux2.yaml (the tiny FLUX.2 with the gated FFN
    and the caption upsampler, T2I): the loader preprocesses the upsampled
    prompts, the epoch's metrics are finite, the replay ratio of the grad
    step is exactly 1.0, the optimizer steps once, the LoRA moves, and no
    kernel launches on the CPU."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models.flux.flux2 import Flux2Adapter
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = Arguments.load_from_yaml(SMOKE)
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    ad = trainer.adapter
    assert isinstance(ad, Flux2Adapter) and ad.caption_upsampler is not None
    assert ad.component_configs["transformer"].mlp_style == "swiglu" and ad.caption_upsampler.max_new_tokens == 6
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in ad.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    rows = [json.loads(line) for line in open(tmp_path / "saves" / "smoke_grpo_flux2" / "metrics.jsonl")]
    train = [r for r in rows if "train/loss" in r]
    assert len(train) == 1 and trainer.global_step == 1
    assert all(np.isfinite(v) for k, v in train[0].items() if k.startswith(("train/", "reward/")))
    stat = lambda key, how: train[0].get(f"{key}_{how}", train[0].get(key))
    assert stat("train/ratio_min", "min") == stat("train/ratio_max", "max") == 1.0
    assert all(s.extra_kwargs["pooled_prompt_embeds"].shape == (32,) for s in trainer.reward_buffer.samples)
    assert max((ad.trainable["transformer"][p]["lora_B"] - b).abs().max().item() for p, b in b0.items()) > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}


# ---------------------------------------------------------------------------
# LTX-2's prompt enhancer
# ---------------------------------------------------------------------------

def test_ltx2_enhanced_prompts_equal_jax():
    """``use_prompt_enhancer`` on the tiny LTX-2 T2AV (its Gemma3 LM alone,
    through the bridge): the enhancer's own template, the rewritten prompts
    equal to JAX's ``enhance_prompt`` and not the prompts as given, the same
    on a second call; without the flag the prompts pass unchanged."""
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter

    model = {"model_type": "ltx2-t2av", "use_prompt_enhancer": True, **ENCODER_ALONE}
    cfg = _config_dict(model=model, train={"trainer_type": "grpo"})
    ja = _jax_adapter(cfg)
    pa = load_adapter(Arguments.from_dict(cfg), device="cpu")
    lm_map = weights.ltx2_component_maps(pa.component_configs)["text_encoder"]
    pa.load_state_dicts({"text_encoder": weights.convert(_host(ja.params["text_encoder"]), *lm_map)})
    assert pa.prompt_enhancer.template.startswith("Expand into a cinematic audio-video scene")
    prompts = ["a cat", "waves on a rocky shore"]
    got = pa.enhance_prompt(prompts)
    assert got == ja.enhance_prompt(prompts) == pa.enhance_prompt(prompts) and got != prompts
    plain = load_adapter(Arguments.from_dict(_config_dict(model={**model, "use_prompt_enhancer": False},
                                                          train={"trainer_type": "grpo"})), device="cpu")
    assert plain.prompt_enhancer is None and plain.enhance_prompt(prompts) == prompts
