"""PyTorch port, the FLUX.1-Kontext slice against the JAX package, fp32 on
the CPU: the condition images' VAE encoding, the stage-1 preprocessing of
``dataset/multi_ref_image`` (a record with two 64 px references and one
with one, padded to the longer), the velocity with the condition tokens, a
rollout with log-probs from the same x0 and noise, the replay ratio in the
rollout order, the GRPO loss, its aux metrics and LoRA gradients against the
JAX ``_grad_fn``, the pin of F13 (the condition ids of the batch's first row
serve every row, in both packages), and one GRPO epoch through
``load_trainer`` on tests/fixtures/smoke_grpo_kontext.yaml.

Both packages run on the JAX adapter's weights and a LoRA with a non-zero
``b`` through the weight bridge; the velocities take the JAX timestep
features (``shared_time_features``, see tests/test_torch_port_flux.py). The
bars are ROADMAP's "Match": a single forward 2e-5, a trajectory 1e-4."""
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATASET = os.path.join(REPO, "dataset", "multi_ref_image")
SMOKE = os.path.join(REPO, "tests", "fixtures", "smoke_grpo_kontext.yaml")
SEED = 13
#: the rollout's rows: the two-reference record twice, then the one-reference record twice
ROWS = [0, 0, 1, 1]


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


def _kontext_config(**train):
    return _config_dict(data={"dataset_dir": DATASET}, model={"model_type": "flux1-kontext"},
                        train={"trainer_type": "grpo", "clip_range": 0.2, "adv_clip_range": 1.5, **train})


def _records():
    """The dataset's records with their reference images loaded as (C, H, W)
    arrays, as the loaders give them to ``preprocess_func``."""
    from flow_factory_tpu_torch.data.dataset import _load_media_fields, load_raw_records

    recs = [_load_media_fields(r, DATASET) for r in load_raw_records(os.path.join(DATASET, "train.jsonl"))]
    return {"prompt": [r["prompt"] for r in recs], "images": [r["images"] for r in recs]}


@pytest.fixture(scope="module")
def both():
    """Both tiny Kontext adapters on the JAX adapter's weights and a LoRA
    with non-zero ``b``; each package's preprocessing of the two records;
    and one Flow-SDE rollout each of the rows ``ROWS`` from the same x0 and
    noise on the JAX package's condition tokens, with the same timestep
    features."""
    from flow_factory_tpu.hparams.args import Arguments as JArgs
    from flow_factory_tpu.models import load_adapter as jax_load
    from flow_factory_tpu.parallel.dist import set_world_size_override
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models import layers as TL
    from flow_factory_tpu_torch.models import load_adapter
    from flow_factory_tpu_torch.utils import weights

    recs = _records()
    prompts = [recs["prompt"][r] for r in ROWS]
    set_world_size_override(1)
    try:
        ja = jax_load(JArgs.from_dict(_kontext_config(model={"attn_backend": "native"})))
        rng = np.random.default_rng(6)
        lora = {p: {"a": ab["a"], "b": (0.05 * rng.standard_normal(ab["b"].shape)).astype(np.float32)}
                for p, ab in _host(ja.trainable["transformer"]).items()}
        ja.trainable = {"transformer": jax.tree.map(jnp.asarray, lora)}
        j_pre = ja.preprocess_func(copy.deepcopy(recs))
        ja.rollout()
        j_samples = ja.inference(prompt=prompts, seed=SEED, cond_latents=j_pre["cond_latents"][ROWS],
                                 cond_ids=j_pre["cond_ids"][ROWS])
        flax_params = _host(ja.params)
    finally:
        set_world_size_override(None)

    pa = load_adapter(Arguments.from_dict(_kontext_config()), device="cpu")
    pa.load_state_dicts(weights.flux1_state_dicts(flax_params, pa.component_configs))
    module_map = weights.flux1_component_maps(pa.component_configs)["transformer"][0]
    pa.load_lora("transformer", weights.lora_from_flax(lora, module_map))
    p_pre = pa.preprocess_func(copy.deepcopy(recs))
    h, w, c = pa.latent_shape(32, 32)
    x0, noise = _jax_noise(len(ROWS), (h, w, c), ((h // 2) * (w // 2), 4 * c), 4)
    real = TL.sinusoidal_timestep_embedding
    TL.sinusoidal_timestep_embedding = _jax_features
    try:
        pa.rollout()
        p_samples = pa.inference(prompt=prompts, x0=torch.tensor(x0), noise=[torch.tensor(n) for n in noise],
                                 cond_latents=j_pre["cond_latents"][ROWS], cond_ids=j_pre["cond_ids"][ROWS])
    finally:
        TL.sinusoidal_timestep_embedding = real
    pa.train()
    return dict(ja=ja, pa=pa, recs=recs, j_pre=j_pre, p_pre=p_pre, module_map=module_map,
                j_samples=j_samples, p_samples=p_samples)


def test_standardize_image_batch_matches_jax():
    """``standardize_image_batch`` gives the JAX function's (B, C, H, W)
    float32 batch in [0, 1] bit for bit from one PIL image, one (H, W, C)
    uint8 array, one (C, H, W) float array, a (B, C, H, W) array and a list
    of mixed images; an unknown input or output type raises in both."""
    from PIL import Image

    from flow_factory_tpu.utils.media import standardize_image_batch as J
    from flow_factory_tpu_torch.utils.media import standardize_image_batch as T

    rng = np.random.default_rng(2)
    hwc = rng.integers(0, 256, (6, 5, 3), dtype=np.uint8)
    chw = rng.random((3, 6, 5)).astype(np.float32)
    for images in (Image.fromarray(hwc), hwc, chw, np.stack([chw, chw * 0.5]), [Image.fromarray(hwc), chw]):
        ours, theirs = T(images), J(images, output_type="np")
        assert ours.dtype == np.float32 and ours.shape[1:] == (3, 6, 5)
        np.testing.assert_array_equal(ours, theirs)
    for fn in (T, J):
        with pytest.raises(ValueError):
            fn("not an image")
        with pytest.raises(ValueError):
            fn(chw, output_type="tensor")


def test_kontext_encode_image_matches_jax(both):
    """``encode_image`` (the VAE posterior mean, shifted and scaled, packed
    2x2) of the dataset's three 64 px references against the JAX adapter's:
    (3, 256, 16) tokens within the single-forward bar 2e-5; and
    ``AutoencoderKL.encode`` with ``sample`` adds exp(½·logvar)·ε of its
    generator's ε to the mean before the shift and scale."""
    ja, pa, recs = both["ja"], both["pa"], both["recs"]
    imgs = np.stack([im for per in recs["images"] for im in per])
    ours, theirs = pa.encode_image(imgs), ja.encode_image(imgs)
    assert ours.shape == theirs.shape == (3, 256, 16) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=2e-5, rtol=0)

    vae, cfg = pa.modules["vae"], pa.component_configs["vae"]
    x = torch.from_numpy(imgs) * 2.0 - 1.0
    with torch.no_grad():
        mean, logvar = vae.encode_moments(x)
        eps = torch.randn(mean.shape, generator=torch.Generator().manual_seed(4))
        drawn = vae.encode(x, generator=torch.Generator().manual_seed(4), sample=True)
    assert torch.equal(drawn, (mean + torch.exp(0.5 * logvar) * eps - cfg.shift_factor) * cfg.scaling_factor)
    with pytest.raises(ValueError):
        vae.encode(x, sample=True)


def test_kontext_preprocess_matches_jax(both):
    """``preprocess_func`` on dataset/multi_ref_image: the two-reference
    record gives 2 x 256 condition tokens with first id coordinates 1 and 2,
    the one-reference record 256 tokens with coordinate 1 and 256 zero tokens
    with ids −1; ids equal to JAX's exactly, condition tokens 2e-5, the prompt
    embeddings 1e-5."""
    j_pre, p_pre = both["j_pre"], both["p_pre"]
    assert set(p_pre) == set(j_pre) == {"prompt_embeds", "pooled_prompt_embeds", "cond_latents", "cond_ids"}
    lat, ids = p_pre["cond_latents"], p_pre["cond_ids"]
    assert lat.shape == (2, 512, 16) and ids.shape == (2, 512, 3)
    np.testing.assert_array_equal(ids, j_pre["cond_ids"])
    assert set(ids[0, :256, 0]) == {1.0} and set(ids[0, 256:, 0]) == {2.0}
    assert set(ids[1, :256, 0]) == {1.0} and np.all(ids[1, 256:] == -1.0) and not np.any(lat[1, 256:])
    np.testing.assert_array_equal(ids[0, :256, 1:], ids[0, 256:, 1:])
    np.testing.assert_allclose(lat, j_pre["cond_latents"], atol=2e-5, rtol=0)
    for key in ("prompt_embeds", "pooled_prompt_embeds"):
        np.testing.assert_allclose(p_pre[key], j_pre[key], atol=1e-5, rtol=0)


def _velocity_batch(both, rows, lib):
    rng = np.random.default_rng(7)
    pa, pre = both["pa"], both["j_pre"]
    h, w, c = pa.latent_shape(32, 32)
    batch = dict(latents=rng.standard_normal((len(rows), (h // 2) * (w // 2), 4 * c)).astype(np.float32),
                 timestep=np.asarray([750.0, 320.0][: len(rows)], np.float32),
                 prompt_embeds=pre["prompt_embeds"][rows], pooled_prompt_embeds=pre["pooled_prompt_embeds"][rows],
                 img_ids=pa.latent_image_ids(h, w), txt_ids=np.zeros((pre["prompt_embeds"].shape[1], 3), np.float32),
                 cond_latents=pre["cond_latents"][rows], cond_ids=pre["cond_ids"][rows])
    return {**{k: lib(v) for k, v in batch.items()}, "guidance_scale": 3.5}


def test_kontext_velocity_with_condition_tokens_matches_jax(both, shared_time_features):
    """The training velocity with the condition tokens concatenated after
    the target's (64 target + 512 condition + 16 text tokens) and the target
    slice read out, on the LoRA-merged weights: (2, 64, 16) fp32 within the
    single-forward bar 2e-5 of JAX's; and without the condition tokens it
    is FLUX.1's velocity and differs."""
    ja, pa = both["ja"], both["pa"]
    theirs = np.asarray(ja.training_velocity(ja.trainable, _velocity_batch(both, [0, 1], jnp.asarray)))
    with torch.no_grad():
        batch = _velocity_batch(both, [0, 1], torch.from_numpy)
        ours = pa.training_velocity(pa.trainable, batch)
        plain = pa.training_velocity(pa.trainable, {k: v for k, v in batch.items() if not k.startswith("cond")})
    assert ours.dtype == torch.float32 and ours.shape == theirs.shape == (2, 64, 16)
    np.testing.assert_allclose(ours.numpy(), theirs, atol=2e-5, rtol=0)
    assert np.abs(plain.numpy() - theirs).max() > 1e-3


def test_kontext_rollout_matches_jax(both):
    """The 4-step Flow-SDE rollout with the condition tokens on every step:
    every stored latent and the SDE steps' log-probs within the trajectory
    bar 1e-4, images within 1e-4; each sample keeps its row of the condition
    tokens and ids, as the JAX package's do."""
    pre = both["j_pre"]
    sde = np.nonzero(both["p_samples"][0].extra_kwargs["noise_levels"])[0]
    assert len(sde) == 2
    for row, js, ps in zip(ROWS, both["j_samples"], both["p_samples"]):
        assert type(ps).__name__ == "ImageConditionSample"
        for key in ("cond_latents", "cond_ids"):
            np.testing.assert_array_equal(ps.extra_kwargs[key], pre[key][row])
            np.testing.assert_array_equal(js.extra_kwargs[key], pre[key][row])
        assert ps.all_latents.shape == js.all_latents.shape == (5, 64, 16)
        np.testing.assert_allclose(ps.all_latents, js.all_latents, atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.log_probs[sde], js.log_probs[sde], atol=1e-4, rtol=0)
        np.testing.assert_allclose(ps.image, js.image, atol=1e-4, rtol=0)
    uids = [s.unique_id for s in both["p_samples"]]
    assert uids[0] == uids[1] != uids[2] == uids[3]


def test_kontext_replay_ratio_is_exactly_one_in_the_rollout_order(both, shared_time_features):
    """The no-grad replay over Kontext's embed keys (the condition tokens and
    ids from each sample's ``extra_kwargs``) in the rollout's row order gives
    exp(new − old) == 1.0 exactly on every stored step."""
    pa, samples = both["pa"], both["p_samples"]
    new = pa.replay_log_probs(samples)
    old = np.stack([s.log_probs for s in samples], axis=1)
    assert sorted(new) == [0, 1, 2, 3]
    for i, lp in new.items():
        assert np.all(np.exp(lp.numpy().astype(np.float64) - old[i]) == 1.0), i


def _step_batch(samples, step, lib, old_shift=None, advantage=None):
    """The GRPO batch of ``samples`` at rollout step ``step``."""
    from flow_factory_tpu_torch.samples import stack_samples

    bn = stack_samples(samples)
    s0 = samples[0]
    lat_map = s0.latent_index_map
    sig, nl = s0.extra_kwargs["sigmas"], s0.extra_kwargs["noise_levels"]
    full = lambda v: np.full((len(samples),), v, np.float32)
    old = bn["log_probs"][:, s0.log_prob_index_map[step]].astype(np.float32)
    batch = dict(latents=bn["all_latents"][:, lat_map[step]], next_latents=bn["all_latents"][:, lat_map[step + 1]],
                 timestep=full(s0.timesteps[step]), sigma=full(sig[step]), sigma_next=full(sig[step + 1]),
                 noise_level=full(nl[step]), sigma_max=full(sig[1]),
                 old_log_prob=old if old_shift is None else (old + old_shift).astype(np.float32),
                 advantage=np.zeros(len(samples), np.float32) if advantage is None else advantage,
                 **{k: np.stack([getattr(s, k) for s in samples]).astype(np.float32)
                    for k in ("prompt_embeds", "pooled_prompt_embeds", "img_ids", "txt_ids", "cond_latents",
                              "cond_ids")})
    return {**{k: lib(np.ascontiguousarray(v)) for k, v in batch.items()}, "guidance_scale": 3.5}


def test_kontext_grpo_loss_and_lora_grads_match_jax(both, shared_time_features):
    """One rollout micro-batch at its first SDE step through the JAX
    GRPO ``_grad_fn`` and the port's ``loss_and_grads``, with the old
    log-probs moved so that the clip (0.2) binds on two rows and not on the
    other two: loss and every aux metric 1e-5 (relative, absolute below 1e-7),
    every LoRA gradient leaf, the fused ``linear1``/``linear2`` included,
    1e-4 of its max."""
    from flow_factory_tpu.trainers.grpo import GRPOTrainer as JGRPO
    from flow_factory_tpu_torch.trainers.grpo import GRPOTrainer
    from test_torch_port_train import _leaf_close, _port_grads_as_flax

    ja, pa, samples = both["ja"], both["pa"], both["p_samples"]
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
                jax.tree.map(np.asarray, j_grads)["transformer"], 1e-4, "kontext grpo")


def test_f13_mixed_geometry_replay_order_is_pinned_in_both_packages(both, shared_time_features):
    """F13: the velocity takes the condition ids of the batch's first row for
    every row. The rollout ran rows 2-3 (the one-reference record) under row
    0's ids (the two-reference record's). Replaying rows 2 and 1 in that
    order gives both rows the one-reference record's ids, with its −1
    padding: the ratio exp(new − old) is not 1.0 on either row, in either
    package, and the two packages' log-ratios agree within the trajectory bar
    1e-4. Fixing F13 takes per-row condition ids, so per-row RoPE, in both."""
    ja, pa = both["ja"], both["pa"]
    step = int(np.nonzero(pa.scheduler.get_noise_levels())[0][0])
    ratios = []
    for adapter, samples, lib in ((ja, both["j_samples"], jnp.asarray), (pa, both["p_samples"], torch.from_numpy)):
        pair = [samples[2], samples[1]]
        batch = _step_batch(pair, step, lib)
        with torch.no_grad():
            out = adapter.training_forward(adapter.trainable, batch)
        ratios.append(np.asarray(out.log_prob, np.float64) - np.asarray(batch["old_log_prob"], np.float64))
    for log_ratio in ratios:
        assert np.all(np.abs(log_ratio) > 1e-4), log_ratio
    np.testing.assert_allclose(ratios[1], ratios[0], atol=1e-4, rtol=0)


def test_kontext_grpo_epoch_through_load_trainer(tmp_path):
    """``load_trainer(cfg, device="cpu").start()`` on
    tests/fixtures/smoke_grpo_kontext.yaml (the port's counterpart of
    ``test_baseline_configs.py::test_kontext_i2i_grpo_epoch``): the loader
    preprocesses dataset/multi_ref_image, the rollouts carry each record's
    condition tokens (512 a row, the one-reference record padded with ids
    −1), the epoch's metrics are finite, the optimizer steps once, the LoRA
    moves, and no kernel launches on the CPU. The micro-batches mix the two
    records, so F13 moves some ratios off 1.0 (clip_frac > 0)."""
    from flow_factory_tpu_torch import ops
    from flow_factory_tpu_torch.hparams import Arguments
    from flow_factory_tpu_torch.models.flux.kontext import Flux1KontextAdapter
    from flow_factory_tpu_torch.trainers import load_trainer

    cfg = Arguments.load_from_yaml(SMOKE)
    cfg.data_args.cache_dir = str(tmp_path / "cache")
    cfg.log_args.save_dir = str(tmp_path / "saves")
    trainer = load_trainer(cfg, device="cpu")
    assert isinstance(trainer.adapter, Flux1KontextAdapter)
    b0 = {p: ab["lora_B"].detach().clone() for p, ab in trainer.adapter.trainable["transformer"].items()}
    ops.reset_launch_counts()
    try:
        trainer.start()
    finally:
        trainer.cleanup()
    rows = [json.loads(line) for line in open(tmp_path / "saves" / "smoke_grpo_kontext" / "metrics.jsonl")]
    train = [r for r in rows if "train/loss" in r]
    assert len(train) == 1 and trainer.global_step == 1
    assert all(np.isfinite(v) for k, v in train[0].items() if k.startswith(("train/", "reward/")))
    assert train[0]["train/grad_norm"] > 0 and train[0]["train/ratio_min_min"] < 1.0
    samples = trainer.reward_buffer.samples
    assert len(samples) == 4
    for s in samples:
        assert s.extra_kwargs["cond_latents"].shape == (512, 16) and s.extra_kwargs["cond_ids"].shape == (512, 3)
    assert sorted(float(s.extra_kwargs["cond_ids"][-1, 0]) for s in samples) == [-1.0, -1.0, 2.0, 2.0]
    assert max((trainer.adapter.trainable["transformer"][p]["lora_B"] - b).abs().max().item()
               for p, b in b0.items()) > 0
    assert ops.launch_counts() == {name: 0 for name in ops.KERNEL_WRAPPERS}
