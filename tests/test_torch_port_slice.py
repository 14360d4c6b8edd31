"""PyTorch port, the slice as a whole: the tiny SD3.5 adapter in both
packages on the same weights (the JAX adapter's random init, carried across
by the weight bridge), the same prompts, and the x0 and per-step noise the
JAX rollout drew — encode → Flow-SDE rollout with log-probs → decode →
brightness reward → group advantages, then the port's no-grad replay.
fp32 on the CPU."""
import jax
import numpy as np
import pytest
import torch

PROMPTS = ["a photo of a red fox in the snow"] * 2 + ["a bowl of ramen with chopsticks"] * 2
SEED = 7


def _port_config():
    from flow_factory_tpu_torch.hparams import Arguments

    # the same settings as __graft_entry__._make_config(tiny=True)
    return Arguments.from_dict({
        "data": {"dataset_dir": "tests/fixtures/tiny_prompts"},
        "model": {"model_type": "sd3-5", "model_name_or_path": "tiny", "variant": "tiny",
                  "finetune_type": "lora", "attn_backend": "auto", "master_dtype": "float32",
                  "inference_dtype": "float32"},
        "scheduler": {"dynamics_type": "Flow-SDE", "noise_level": 0.7, "num_sde_steps": 2,
                      "sde_steps": [0, 1, 2]},
        "train": {"trainer_type": "grpo", "resolution": 32, "num_inference_steps": 4,
                  "guidance_scale": 2.0, "per_device_batch_size": 1, "group_size": 1,
                  "unique_sample_num_per_epoch": 1, "latent_storage_dtype": "fp32", "ema_decay": 0},
        "eval": {}, "log": {}, "rewards": [],
    })


def _jax_noise(B, shape, T):
    """The x0 and per-step noise the JAX adapter draws for ``seed=SEED``
    (``sd3/adapter.py:413-419`` and the scan body, ``abc.py:976``)."""
    import jax.numpy as jnp
    from flow_factory_tpu.utils.base import derive_key

    keys = jax.random.split(derive_key("rollout", SEED), B)
    x0 = np.asarray(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))
    k = jax.random.fold_in(keys[0], 7)
    noise = []
    for _ in range(T):
        k, sub = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(sub, (B, *shape), jnp.float32)))
    return x0, noise


@pytest.fixture(scope="module")
def both():
    from __graft_entry__ import _make_config
    from flow_factory_tpu.advantage import AdvantageProcessor as JAdv
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu.rewards.models import MyReward as JReward
    from flow_factory_tpu.hparams.reward_args import RewardArguments as JRArgs
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    set_world_size_override(1)
    try:
        ja = jax_load(_make_config(tiny=True))
        j_samples = ja.inference(prompt=PROMPTS, seed=SEED)
        j_rewards = JReward(JRArgs(name="brightness", reward_model="MyReward")).compute_reward(
            image=[s.image for s in j_samples], prompt=PROMPTS)
        for s, r in zip(j_samples, j_rewards):
            s.extra_kwargs["rewards"] = {"brightness": float(r)}
        JAdv(group_size=2).compute_advantages(j_samples)
        flax_params = jax.tree.map(np.asarray, jax.device_get(ja.params))
    finally:
        set_world_size_override(None)

    pa = load_adapter(_port_config(), device="cpu")
    pa.load_state_dicts(weights.sd35_state_dicts(flax_params, pa.component_configs))
    h, w, c = pa.latent_shape(32, 32)
    x0, noise = _jax_noise(len(PROMPTS), (h, w, c), 4)
    p_samples = pa.inference(prompt=PROMPTS, x0=torch.tensor(x0), noise=[torch.tensor(n) for n in noise])
    return ja, j_samples, pa, p_samples


def test_prompt_embeddings_match_jax(both):
    """CLIP-L + CLIP-G penultimate states padded and joined with T5, and the
    pooled projections: 1e-5."""
    _, j_samples, _, p_samples = both
    for js, ps in zip(j_samples, p_samples):
        np.testing.assert_allclose(ps.prompt_embeds, js.prompt_embeds, atol=1e-5)
        np.testing.assert_allclose(ps.negative_prompt_embeds, js.negative_prompt_embeds, atol=1e-5)
        np.testing.assert_allclose(ps.extra_kwargs["pooled_prompt_embeds"],
                                   js.extra_kwargs["pooled_prompt_embeds"], atol=1e-5)


def test_schedule_matches_jax(both):
    _, j_samples, _, p_samples = both
    np.testing.assert_allclose(p_samples[0].timesteps, j_samples[0].timesteps, atol=1e-4)
    np.testing.assert_allclose(p_samples[0].extra_kwargs["sigmas"], j_samples[0].extra_kwargs["sigmas"],
                               atol=1e-6)
    np.testing.assert_array_equal(p_samples[0].extra_kwargs["noise_levels"],
                                  j_samples[0].extra_kwargs["noise_levels"])
    np.testing.assert_array_equal(p_samples[0].latent_index_map, j_samples[0].latent_index_map)


def test_trajectory_matches_jax(both):
    """Every stored latent of the 4-step CFG Flow-SDE rollout: 1e-4, the
    trajectory bar of tests/test_torch_reference.py."""
    _, j_samples, _, p_samples = both
    for js, ps in zip(j_samples, p_samples):
        assert ps.all_latents.shape == js.all_latents.shape == (5, 16, 16, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4)


def test_log_probs_match_jax(both):
    """Per-step log-probs: 1e-3. A latent difference d moves a Gaussian
    log-prob by ~d*|x'-mean|/scale^2 per element (scale ~0.3 here), so the
    1e-4 trajectory bar allows ~1e-3; zero-noise steps give the clamped
    constant on both sides."""
    _, j_samples, _, p_samples = both
    for js, ps in zip(j_samples, p_samples):
        np.testing.assert_allclose(ps.log_probs, js.log_probs, atol=1e-3)


def test_images_rewards_and_advantages_match_jax(both):
    """Decoded images 1e-4; brightness rewards 1e-5 (means of images); group
    advantages 1e-3 (centred and divided by a reward std ~1e-3 wide)."""
    from flow_factory_tpu_torch.advantage import AdvantageProcessor
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.rewards import RewardProcessor, load_reward_models

    _, j_samples, _, p_samples = both
    for js, ps in zip(j_samples, p_samples):
        assert ps.image.shape == (3, 32, 32)
        np.testing.assert_allclose(ps.image, js.image, atol=1e-4)
    rewards = Arguments.from_dict({"rewards": [{"name": "brightness", "reward_model": "MyReward"}]}).reward_args
    RewardProcessor(load_reward_models(rewards)).score_and_attach(p_samples)
    metrics = AdvantageProcessor(group_size=2).compute_advantages(p_samples)
    for js, ps in zip(j_samples, p_samples):
        assert abs(ps.extra_kwargs["rewards"]["brightness"] - js.extra_kwargs["rewards"]["brightness"]) < 1e-5
        assert abs(ps.extra_kwargs["advantage"] - js.extra_kwargs["advantage"]) < 1e-3
    assert np.isfinite(metrics["advantage/std"])


def test_port_replay_ratio_is_exactly_one(both):
    """The no-grad replay of every stored transition gives exp(new - old) == 1.0."""
    _, _, pa, p_samples = both
    new = pa.replay_log_probs(p_samples)
    old = np.stack([s.log_probs for s in p_samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), i


def test_port_rollout_from_its_own_generator_is_seed_deterministic(both):
    _, _, pa, _ = both
    a = pa.inference(prompt=PROMPTS[:2], seed=3, decode=False)
    b = pa.inference(prompt=PROMPTS[:2], seed=3, decode=False)
    np.testing.assert_array_equal(a[0].all_latents, b[0].all_latents)
    np.testing.assert_array_equal(a[1].log_probs, b[1].log_probs)
