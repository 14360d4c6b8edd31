"""PyTorch port, the LTX-2 adapters and GRPO training against the JAX
package, fp32 on the CPU: the tiny T2AV adapter's joint rollout (video
latents and log-probs, audio latents on their own ODE grid, decoded video
and waveform) from the same x0 and per-step noise as the JAX adapter's,
with CFG and with STG plus modality isolation; the no-grad replay of every
stored transition with the stored audio latent of the same slot; one GRPO
run through ``load_trainer`` on tests/fixtures/smoke_grpo_ltx2.yaml; the
I2AV adapter's planted first-frame tokens, its rollout against JAX's, and
the fractional-mask path; the registry.

Both packages run on the JAX adapter's weights and a LoRA with a non-zero
``b`` through the weight bridge, on the JAX adapter's prompt embeddings,
and the velocities take the JAX timestep features (``_jax_features``,
tests/test_torch_port_flux.py). The bar is ROADMAP's trajectory "Match":
1e-4. One JAX adapter serves every JAX rollout here; the STG run and the
I2AV adapter (the same weights under the I2AV class) retrace it after
``jax.clear_caches()``, as the JAX adapter itself does when a path flag
changes."""
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_threads import one_torch_thread  # noqa: F401

from test_torch_port_flux import _config_dict, _host, _jax_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "tests", "fixtures", "smoke_grpo_ltx2.yaml")
IMAGES = os.path.join(REPO, "dataset", "sharegpt4o_image_mini")
PROMPTS = ["a drummer playing a fast jazz solo", "rain hammering a tin roof"]
SEED = 13
STG = {"stg_scale": 1.0, "spatio_temporal_guidance_blocks": [1], "modality_scale": 2.0}


@pytest.fixture(autouse=True, scope="module")
def _isolated():
    """The JAX package's world-size override is process-wide: reset it before
    and after this module (F0)."""
    from flow_factory_tpu.parallel.dist import set_world_size_override

    set_world_size_override(None)
    yield
    set_world_size_override(None)


def _ltx2_config(model_type="ltx2-t2av", **model):
    return _config_dict(
        data={"dataset_dir": "dataset/av_prompt"},
        model={"model_type": model_type, **model},
        train={"trainer_type": "grpo", "resolution": 16, "num_inference_steps": 4, "guidance_scale": 3.0,
               "num_frames": 5, "clip_range": 0.2, "adv_clip_range": 1.5})


def _jax_noise(B, Lv, Cv, La, Ca, T):
    """The x0 of both streams and the per-step video noise the JAX adapter
    draws for ``seed=SEED`` (``ltx2/t2av.py:674-691`` and the scan body)."""
    from flow_factory_tpu.utils.base import derive_key

    keys = jax.random.split(derive_key("rollout", SEED), B)
    v0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (Lv, Cv), jnp.float32))(keys))
    a0 = np.asarray(jax.vmap(lambda k: jax.random.normal(jax.random.fold_in(k, 1), (La, Ca), jnp.float32))(keys))
    k = jax.random.fold_in(keys[0], 7)
    noise = []
    for _ in range(T):
        k, sub = jax.random.split(k)
        noise.append(torch.from_numpy(np.asarray(jax.random.normal(sub, (B, Lv, Cv), jnp.float32))))
    return (torch.from_numpy(v0), torch.from_numpy(a0)), noise


def _port_rollout(pa, embeds, **kw):
    from flow_factory_tpu_torch.models import layers as TL

    tl, h, w = pa.video_token_geometry(16, 16, 5)
    B = len(embeds["prompt_embeds"])
    x0, noise = _jax_noise(B, tl * h * w, pa.video_latent_channels, pa.audio_token_count(5),
                           pa.audio_latent_channels, 4)
    real = TL.sinusoidal_timestep_embedding
    TL.sinusoidal_timestep_embedding = _jax_features
    try:
        pa.rollout()
        return pa.inference(prompt=PROMPTS[:B], x0=x0, noise=noise, **embeds, **kw)
    finally:
        TL.sinusoidal_timestep_embedding = real
        pa.train()


@pytest.fixture(scope="module")
def both():
    """One tiny JAX T2AV adapter and both port adapters (T2AV, I2AV) on its
    weights and a LoRA with non-zero ``b``; the JAX rollouts with CFG, with
    STG plus isolation, and of the I2AV class on the first frames of two
    dataset images; the port's rollouts from the same inputs."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.models.ltx2 import LTX2I2AVAdapter as JI2AV
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.data.dataset import _load_media_fields, load_raw_records
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    recs = [_load_media_fields(r, IMAGES) for r in load_raw_records(os.path.join(IMAGES, "train.jsonl"))[:2]]
    images = [r["images"][0] for r in recs]
    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_ltx2_config(attn_backend="native")))
        rng = np.random.default_rng(6)
        lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for p, ab in _host(ja.trainable["transformer"]).items()}
        ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
        pre = ja.preprocess_func({"prompt": PROMPTS})
        embeds = {k: pre[k] for k in ("prompt_embeds", "negative_prompt_embeds")}
        ja.rollout()
        j_cfg = ja.inference(prompt=PROMPTS, seed=SEED, **embeds)
        ja.training_args.extra_kwargs.update(STG)
        jax.clear_caches()
        j_stg = ja.inference(prompt=PROMPTS, seed=SEED, **embeds)
        for k in STG:
            ja.training_args.extra_kwargs.pop(k)
        ji = JI2AV.__new__(JI2AV)
        ji.__dict__.update(ja.__dict__)
        jax.clear_caches()
        j_tokens, j_mask = ji.encode_first_frame(images, 16, 16, 5)
        j_i2av = ji.inference(prompt=PROMPTS, seed=SEED, cond_tokens=j_tokens, cond_mask=j_mask, **embeds)
        flax_params = _host(ja.params)
    finally:
        set_world_size_override(None)

    out = dict(ja=ja, lora=lora, embeds=embeds, images=images, j_cfg=j_cfg, j_stg=j_stg, j_i2av=j_i2av,
               j_tokens=j_tokens, j_mask=j_mask, flax_params=flax_params)
    for key, model_type in (("pa", "ltx2-t2av"), ("pi", "ltx2-i2av")):
        ad = load_adapter(Arguments.from_dict(_ltx2_config(model_type)), device="cpu")
        ad.load_state_dicts(weights.ltx2_state_dicts(flax_params, ad.component_configs))
        module_map = weights.ltx2_component_maps(ad.component_configs)["transformer"][0]
        ad.load_lora("transformer", weights.lora_from_flax(lora, module_map))
        out[key] = ad
    pa, pi = out["pa"], out["pi"]
    out["p_cfg"] = _port_rollout(pa, embeds)
    pa.training_args.extra_kwargs.update(STG)
    try:
        out["p_stg"] = _port_rollout(pa, embeds)
    finally:
        for k in STG:
            pa.training_args.extra_kwargs.pop(k)
    out["p_i2av"] = _port_rollout(pi, embeds, cond_tokens=j_tokens, cond_mask=j_mask)
    return out


def _same_trajectory(js, ps):
    sde = np.nonzero(ps[0].extra_kwargs["noise_levels"])[0]
    assert len(sde) == 2
    np.testing.assert_array_equal(ps[0].extra_kwargs["sigmas"], js[0].extra_kwargs["sigmas"])
    np.testing.assert_array_equal(ps[0].extra_kwargs["audio_sigmas"], js[0].extra_kwargs["audio_sigmas"])
    for j, p in zip(js, ps):
        assert p.all_latents.shape == j.all_latents.shape == (5, 48, 16)
        assert p.extra_kwargs["audio_all_latents"].shape == j.extra_kwargs["audio_all_latents"].shape == (5, 39, 8)
        np.testing.assert_allclose(p.all_latents, j.all_latents, atol=1e-4, rtol=0)
        np.testing.assert_allclose(p.extra_kwargs["audio_all_latents"], j.extra_kwargs["audio_all_latents"],
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(p.log_probs[sde], j.log_probs[sde], atol=1e-4, rtol=0)
        assert p.video.shape == j.video.shape == (5, 3, 16, 16) and p.audio.shape == j.audio.shape == (1, 4992)
        np.testing.assert_allclose(p.video, j.video, atol=1e-4, rtol=0)
        np.testing.assert_allclose(p.audio, j.audio, atol=1e-4, rtol=0)
        for key in ("video_ids", "audio_ids"):
            np.testing.assert_array_equal(p.extra_kwargs[key], j.extra_kwargs[key])


@pytest.mark.parametrize("which", ["cfg", "stg"])
def test_ltx2_rollout_matches_jax(both, which):
    """The 4-step rollout of 2 prompts at 16 px x 5 frames (48 video tokens
    of 16 channels, 39 audio tokens of 8): the video Flow-SDE trajectory and
    the log-probs of its 2 SDE steps, the audio ODE trajectory on its own
    sigma grid, the decoded (5, 3, 16, 16) videos and (1, 4992) waveforms,
    all within 1e-4 of JAX's, with CFG 3 alone and with CFG, STG (block 1
    skipped, scale 1) and modality isolation (scale 2) composed in x0
    space."""
    _same_trajectory(both[f"j_{which}"], both[f"p_{which}"])


def test_ltx2_encode_prompt_matches_jax(both):
    """The tiny LM's 16-token prompt embeddings (pad rows included) and the
    empty negative prompt's, within 2e-5 of the JAX adapter's."""
    ours = both["pa"].preprocess_func({"prompt": PROMPTS})
    for key in ("prompt_embeds", "negative_prompt_embeds"):
        assert ours[key].shape == (2, 16, 32)
        np.testing.assert_allclose(ours[key], both["embeds"][key], atol=2e-5, rtol=0)


@pytest.mark.parametrize("which", ["cfg", "stg", "i2av"])
def test_ltx2_replay_ratio_is_exactly_one(both, which, monkeypatch):
    """The no-grad replay of every stored step, each with the stored audio
    latent of its slot: new log-probs equal the rollout's bit for bit, ratio
    exactly 1.0 (I2AV: over the generated tokens only)."""
    from flow_factory_tpu_torch.models import layers as TL

    monkeypatch.setattr(TL, "sinusoidal_timestep_embedding", _jax_features)
    ad = both["pi" if which == "i2av" else "pa"]
    if which == "stg":
        for k, v in STG.items():
            monkeypatch.setitem(ad.training_args.extra_kwargs, k, v)
    samples = both[f"p_{which}"]
    new = ad.replay_log_probs(samples)
    old = np.stack([s.log_probs for s in samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.array_equal(lp.numpy(), old[i]), i


def test_ltx2_i2av_plants_first_frame_tokens_like_jax(both):
    """I2AV on the first two dataset images (16 px): the port's first-frame
    tokens (the VAE's first latent frame, 16 of 48 tokens, mask 1 there)
    within 2e-5 of JAX's; the rollout from the JAX tokens within 1e-4 of
    JAX's; the planted tokens equal in every stored latent of every sample,
    so they never step; and the log-prob counts only the generated tokens:
    the rollout's SDE-step log-probs equal ``sde_step``'s with the token
    mask, not without it."""
    from flow_factory_tpu_torch.scheduler.flow_match_euler import sde_step

    pi, p_i2av = both["pi"], both["p_i2av"]
    tokens, mask = pi.encode_first_frame(both["images"], 16, 16, 5)
    np.testing.assert_array_equal(mask, both["j_mask"])
    assert mask[:, :16].min() == 1.0 and mask[:, 16:].max() == 0.0
    np.testing.assert_allclose(tokens, both["j_tokens"], atol=2e-5, rtol=0)
    _same_trajectory(both["j_i2av"], p_i2av)
    for i, s in enumerate(p_i2av):
        planted = both["j_tokens"][i, :16]
        for slot in range(s.all_latents.shape[0]):
            assert np.array_equal(s.all_latents[slot, :16], planted), (i, slot)
        assert np.array_equal(s.extra_kwargs["cond_tokens"], both["j_tokens"][i])

    # the log-prob of step 1 re-evaluated from the stored velocity-free terms
    lat = torch.from_numpy(np.stack([s.all_latents for s in p_i2av]))
    sig = p_i2av[0].extra_kwargs["sigmas"]
    v = torch.randn(lat[:, 1].shape, generator=torch.Generator().manual_seed(0))
    tm = torch.from_numpy(np.stack([(s.extra_kwargs["cond_mask"] <= 0.0) for s in p_i2av]).astype(np.float32))
    masked = sde_step(v, lat[:, 1], float(sig[1]), float(sig[2]), noise_level=0.7, next_latents=lat[:, 2],
                      token_mask=tm).log_prob
    whole = sde_step(v, lat[:, 1], float(sig[1]), float(sig[2]), noise_level=0.7, next_latents=lat[:, 2]).log_prob
    assert not torch.allclose(masked, whole)
    assert pi.token_mask({"cond_mask": torch.from_numpy(both["j_mask"])}).sum().item() == 2 * 32


def test_ltx2_i2av_fractional_mask_turns_per_token_time_on(both, monkeypatch):
    """A fractional mask (0.7 on the first frame) plants clean·0.7 +
    noise·0.3 with the JAX adapter's numpy noise, turns ``per_token_time``
    on (every video token embeds its own t·(1 − mask)), and the rollout of
    the port matches JAX's on the same inputs; an explicit
    ``per_token_time: false`` refuses such a mask."""
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu.models.ltx2 import LTX2I2AVAdapter as JI2AV

    pi, ja = both["pi"], both["ja"]
    frac = both["j_mask"] * 0.7
    ji = JI2AV.__new__(JI2AV)
    ji.__dict__.update(ja.__dict__)
    ji.training_args = copy.deepcopy(ja.training_args)
    monkeypatch.setattr(pi, "training_args", copy.deepcopy(pi.training_args))
    set_world_size_override(1)
    try:
        jax.clear_caches()
        j = ji.inference(prompt=PROMPTS, seed=SEED, cond_tokens=both["j_tokens"], cond_mask=frac, **both["embeds"])
    finally:
        set_world_size_override(None)
    p = _port_rollout(pi, both["embeds"], cond_tokens=both["j_tokens"], cond_mask=frac, seed=SEED)
    assert pi.per_token_time and ji.per_token_time
    _same_trajectory(j, p)
    rng = np.random.default_rng(np.uint64(SEED + 0x12A5))
    noise = rng.standard_normal(both["j_tokens"].shape).astype(np.float32)
    want = np.where(frac > 0, both["j_tokens"] * frac + noise * (1 - frac), 0.0).astype(np.float32)
    for i, s in enumerate(p):
        np.testing.assert_array_equal(s.extra_kwargs["cond_tokens"], want[i])
        assert np.array_equal(s.all_latents[-1, :16], want[i, :16])
    pi.training_args.extra_kwargs["per_token_time"] = False
    with pytest.raises(ValueError, match="per_token_time"):
        pi.inference(prompt=PROMPTS, cond_tokens=both["j_tokens"], cond_mask=frac, decode=False, **both["embeds"])


def test_ltx2_grpo_run_has_ratio_one_and_replays_the_audio_stream(tmp_path):
    """``load_trainer(...).start()`` on tests/fixtures/smoke_grpo_ltx2.yaml
    (tiny LTX-2 T2AV, CFG 3, bf16 trajectory storage, 2 epochs of 2 grad
    steps): a spy on ``training_forward`` sees the staged audio latents of
    the grad step's slot in every batch, equal to the rollout's stored
    audio latents there; the ratio is exactly 1.0 with no clipping on every
    step; the grad norm > 0 and the LoRA ``B`` moves."""
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = Arguments.load_from_yaml(SMOKE)
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    ad = trainer.adapter
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in ad.trainable["transformer"].items()}
    seen = []
    real = ad.training_forward

    def spy(trainable, batch, **kw):
        seen.append((batch.get("audio_latents"), batch["latents"], batch["timestep"][0].item()))
        return real(trainable, batch, **kw)

    ad.training_forward = spy
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    rows = [json.loads(line) for line in open(tmp_path / "saves" / cfg.log_args.run_name / "metrics.jsonl")]
    train_rows = [r for r in rows if "train/ratio_mean" in r]
    assert [r["step"] for r in train_rows] == [0, 1]
    for row in train_rows:
        assert row["train/ratio_min"] == row["train/ratio_max"] == 1.0 and row["train/clip_frac"] == 0.0
        assert row["train/grad_norm"] > 0 and np.isfinite(row["train/loss"])
    assert len(seen) % 2 == 0 and all(a is not None and a.shape == (2, 39, 8) for a, _, _ in seen)
    samples = trainer.reward_buffer.samples  # epoch 1's rollout
    stored = {tuple(np.round(s.all_latents[i].reshape(-1)[:4], 6)): s.extra_kwargs["audio_all_latents"][i]
              for s in samples for i in range(s.all_latents.shape[0])}
    for audio, video, _ in seen[len(seen) // 2:]:
        for row in range(2):
            key = tuple(np.round(video[row].numpy().reshape(-1)[:4], 6))
            assert np.array_equal(audio[row].numpy(), stored[key])
    moved = max((ad.trainable["transformer"][p]["lora_B"] - b).abs().max().item() for p, b in b0.items())
    assert moved > 0


def test_ltx2_model_types_resolve():
    """``ltx2-t2av`` and ``ltx2-i2av`` resolve to the port's adapters; the
    decoupled trainers' latent tree holds both streams, as JAX's default
    does (tests/test_torch_port_decoupled_ltx2.py holds the losses)."""
    from flow_factory_tpu_torch.models.ltx2 import LTX2I2AVAdapter, LTX2T2AVAdapter
    from flow_factory_tpu_torch.models.registry import resolve_adapter_class

    assert resolve_adapter_class("ltx2-t2av") is LTX2T2AVAdapter
    assert resolve_adapter_class("ltx2-i2av") is LTX2I2AVAdapter
    for cls in (LTX2T2AVAdapter, LTX2I2AVAdapter):
        assert object.__new__(cls).decoupled_latent_keys == {"latents": "all_latents",
                                                             "audio_latents": "audio_all_latents"}


def test_preprocess_cache_keys_the_model_variant(tmp_path):
    """Two configs that differ only in ``model.variant`` (the tiny and the
    full-width LTX-2 preset of one model type, no checkpoint path) get two
    preprocess caches: a cache left by one is not read by the other."""
    from flow_factory_tpu_torch.data.loader import get_dataloader
    from flow_factory_tpu_torch.hparams import Arguments

    calls = []

    def preprocess(batch, **_):
        calls.append(len(batch["prompt"]))
        return {"prompt_embeds": np.zeros((len(batch["prompt"]), 2), np.float32)}

    for variant in ("tiny", "ltx2", "tiny"):
        cfg = Arguments.from_dict(_ltx2_config(variant=variant))
        cfg.data_args.cache_dir = str(tmp_path)
        get_dataloader(cfg, preprocess)
    assert len(calls) == 2 and len(os.listdir(tmp_path)) == 2
