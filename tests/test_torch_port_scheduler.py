"""PyTorch port, scheduler: sigma schedule and ``sde_step`` against the JAX
package on the same numpy inputs (fp32, CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flow_factory_tpu.scheduler import flow_match_euler as jfm
from flow_factory_tpu_torch.scheduler import flow_match_euler as tfm

DYNAMICS = ["Flow-SDE", "Dance-SDE", "CPS", "ODE"]


@pytest.mark.parametrize("seq_len", [16, 1024, 4096])
def test_calculate_shift_and_sigmas_match_jax(seq_len):
    """mu and the dynamically shifted (T+1,) schedule, plus a static shift and
    a terminal stretch: 1e-6."""
    assert abs(tfm.calculate_shift(seq_len) - jfm.calculate_shift(seq_len)) < 1e-6
    mu = tfm.calculate_shift(seq_len)
    np.testing.assert_allclose(
        tfm.build_flow_match_sigmas(10, use_dynamic_shifting=True, mu=mu),
        jfm.build_flow_match_sigmas(10, use_dynamic_shifting=True, mu=mu), atol=1e-6)
    np.testing.assert_allclose(
        tfm.build_flow_match_sigmas(7, shift=3.0, shift_terminal=0.02),
        jfm.build_flow_match_sigmas(7, shift=3.0, shift_terminal=0.02), atol=1e-6)


def test_scheduler_host_state_matches_jax():
    """Timesteps, the seeded SDE-step subset and per-step noise levels."""
    kw = dict(noise_level=0.8, sde_steps=[1, 2, 3, 4, 5], num_sde_steps=2, seed=42,
              use_dynamic_shifting=True)
    ours, theirs = tfm.FlowMatchEulerSDE(**kw), jfm.FlowMatchEulerSDE(**kw)
    np.testing.assert_allclose(ours.set_timesteps(10, seq_len=1024), theirs.set_timesteps(10, seq_len=1024),
                               atol=1e-6)
    np.testing.assert_array_equal(ours.current_sde_steps, theirs.current_sde_steps)
    np.testing.assert_array_equal(ours.get_noise_levels(), theirs.get_noise_levels())
    ours.eval()
    theirs.eval()
    np.testing.assert_array_equal(ours.get_noise_levels(), theirs.get_noise_levels())


def _inputs(seed, per_sample):
    rng = np.random.default_rng(seed)
    B = 3
    v, x, nxt, noise = (rng.standard_normal((B, 4, 4, 2)).astype(np.float32) for _ in range(4))
    if per_sample:
        sigma = np.asarray([0.9, 0.7, 1.0], np.float32)
        sigma_next = np.asarray([0.8, 0.55, 0.9], np.float32)
        eta = np.asarray([0.7, 0.5, 0.9], np.float32)
    else:
        sigma, sigma_next, eta = np.float32(0.8), np.float32(0.65), np.float32(0.7)
    return v, x, nxt, noise, sigma, sigma_next, eta


def _jax_step(v, x, sigma, sigma_next, eta, dyn, nxt=None, key=None):
    return jfm.sde_step(jnp.asarray(v), jnp.asarray(x), jnp.asarray(sigma), jnp.asarray(sigma_next),
                        dynamics_type=dyn, noise_level=jnp.asarray(eta), key=key,
                        next_latents=None if nxt is None else jnp.asarray(nxt),
                        storage_dtype=jnp.float32, sigma_max=0.95)


def _torch_step(v, x, sigma, sigma_next, eta, dyn, nxt=None, noise=None, storage=torch.float32):
    t = lambda a: torch.from_numpy(np.array(a))
    return tfm.sde_step(t(v), t(x), t(sigma), t(sigma_next), dynamics_type=dyn, noise_level=t(eta),
                        noise=None if noise is None else t(noise),
                        next_latents=None if nxt is None else t(nxt),
                        storage_dtype=storage, sigma_max=0.95)


@pytest.mark.parametrize("dyn", DYNAMICS)
@pytest.mark.parametrize("per_sample", [False, True])
def test_sde_step_replay_matches_jax(dyn, per_sample):
    """Replay mode on the same (v, x, next): log-prob and mean to 1e-6
    (relative for the log-prob, whose magnitude grows as the scale shrinks)."""
    v, x, nxt, _, sigma, sigma_next, eta = _inputs(1, per_sample)
    ours = _torch_step(v, x, sigma, sigma_next, eta, dyn, nxt=nxt)
    theirs = _jax_step(v, x, sigma, sigma_next, eta, dyn, nxt=nxt)
    np.testing.assert_allclose(ours.log_prob.numpy(), np.asarray(theirs.log_prob), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.next_latents_mean.numpy(), np.asarray(theirs.next_latents_mean),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dyn", DYNAMICS)
def test_sde_step_sampling_matches_jax_given_its_noise(dyn):
    """Sampling mode fed the noise JAX drew from its key: next latents and
    log-probs to 1e-6."""
    v, x, _, _, sigma, sigma_next, eta = _inputs(2, True)
    key = jax.random.PRNGKey(5)
    jax_noise = np.asarray(jax.random.normal(key, v.shape, dtype=jnp.float32))
    ours = _torch_step(v, x, sigma, sigma_next, eta, dyn, noise=jax_noise)
    theirs = _jax_step(v, x, sigma, sigma_next, eta, dyn, key=key)
    np.testing.assert_allclose(ours.next_latents.numpy(), np.asarray(theirs.next_latents), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ours.log_prob.numpy(), np.asarray(theirs.log_prob), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dyn", DYNAMICS)
@pytest.mark.parametrize("storage", [torch.bfloat16, torch.float16, torch.float32])
def test_sample_then_replay_ratio_is_exactly_one(dyn, storage):
    """The core invariant at the step level: a sampled transition (round
    tripped through the storage dtype) replays to the identical log-prob."""
    v, x, _, noise, sigma, sigma_next, eta = _inputs(3, True)
    gen = torch.Generator().manual_seed(0)
    t = lambda a: torch.from_numpy(np.array(a))
    out = tfm.sde_step(t(v), t(x), t(sigma), t(sigma_next), dynamics_type=dyn, noise_level=t(eta),
                       generator=gen, storage_dtype=storage)
    replay = tfm.sde_step(t(v), t(x), t(sigma), t(sigma_next), dynamics_type=dyn, noise_level=t(eta),
                          next_latents=out.next_latents, storage_dtype=storage)
    assert torch.equal(out.next_latents, out.next_latents.to(storage).float())
    assert torch.all(torch.exp(replay.log_prob - out.log_prob) == 1.0)


def test_token_mask_freezes_conditioned_tokens_like_jax():
    v, x, nxt, _, sigma, sigma_next, eta = _inputs(4, False)
    mask = np.zeros((3, 4, 4, 1), np.float32)
    mask[:, :, 2:] = 1.0
    ours = tfm.sde_step(*(torch.from_numpy(np.array(a)) for a in (v, x, sigma, sigma_next)),
                        noise_level=float(eta), next_latents=torch.from_numpy(nxt),
                        token_mask=torch.from_numpy(mask), storage_dtype=torch.float32)
    theirs = jfm.sde_step(jnp.asarray(v), jnp.asarray(x), sigma, sigma_next, noise_level=float(eta),
                          next_latents=jnp.asarray(nxt), token_mask=jnp.asarray(mask),
                          storage_dtype=jnp.float32)
    np.testing.assert_allclose(ours.log_prob.numpy(), np.asarray(theirs.log_prob), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ours.next_latents.numpy()[:, :, :2], x[:, :, :2])


def test_sampling_without_noise_source_raises():
    z = torch.zeros(1, 2, 2, 1)
    with pytest.raises(ValueError):
        tfm.sde_step(z, z, 0.5, 0.4, noise_level=0.7)
